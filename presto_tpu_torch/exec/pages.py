"""Page wire format: Batch <-> bytes for spill (and, later, exchange and
clients).

The counterpart of ``presto_tpu/exec/pages.py`` (the role of the
reference's PagesSerde, presto-main/.../execution/buffer/
PagesSerde.java:42-60: length-prefixed block encodings, optional
compression, a marker byte), byte for byte the same format:

- live rows are compacted on the host before encoding (the wire carries
  no padding or dead rows);
- per column: the packed validity bitmap (little bit order), then the
  raw little-endian storage array (BOOLEAN as u8; long decimals and
  other fixed-width vector columns row-major, ``storage_width`` values
  per row);
- the header is compact JSON: names, type displays (they round-trip
  through ``types.parse_type``), the row count and each string column's
  vocabulary;
- one marker byte selects compression: zlib level 1 when it shrinks a
  payload of more than 256 bytes.

ARRAY and MAP columns have no wire form yet.

The producer half of the cluster's exchange is ``serialize_partitioned``:
it hash-partitions a batch's live rows with the mesh exchange's value
hash (``parallel/exchange.hash_partition_ids``), so both sides of a
partitioned join land matching rows in the same buffer, and encodes one
page per non-empty partition. A batch on the GPU crosses to the host
once, all its columns and the partition ids together, and is sliced
there.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import NUMPY_DTYPE, Batch, Schema

MAGIC = b"PTPG"
_VERSION = 1
_MARKER_ZLIB = 1


def _header(schema: Schema, n: int,
            dicts: List[Optional[Tuple[str, ...]]]) -> bytes:
    doc = {
        "names": schema.names,
        "types": [t.display() for t in schema.types],
        "n": n,
        "dicts": [list(d) if d is not None else None for d in dicts],
    }
    return json.dumps(doc, separators=(",", ":")).encode("utf-8")


def _encode(schema: Schema, arrays: List[np.ndarray],
            valids: List[np.ndarray],
            dicts: List[Optional[Tuple[str, ...]]],
            compress: bool) -> bytes:
    n = len(arrays[0]) if arrays else 0
    parts: List[bytes] = []
    for data, valid in zip(arrays, valids):
        parts.append(np.packbits(valid, bitorder="little").tobytes())
        if data.dtype == np.bool_:
            data = data.astype(np.uint8)
        parts.append(np.ascontiguousarray(data).tobytes())
    header = _header(schema, n, dicts)
    payload = struct.pack("<I", len(header)) + header + b"".join(parts)
    marker = 0
    if compress and len(payload) > 256:
        squeezed = zlib.compress(payload, level=1)
        if len(squeezed) < len(payload):
            payload, marker = squeezed, _MARKER_ZLIB
    return MAGIC + struct.pack("<BB", _VERSION, marker) + payload


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host numpy copies of ``tensors``. From the GPU the copies are
    queued on the stream into pinned buffers and waited for once, so a
    batch costs one synchronization, not one per column."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.cpu().numpy() for t in tensors]
    outs = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        outs.append(h)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in outs]


def _host_columns(batch: Batch, extra: Optional[torch.Tensor] = None):
    """(row mask, live data, live validity, vocabularies, live ``extra``)
    of a batch as host numpy arrays, copied from the device together."""
    for c in batch.columns:
        if isinstance(c.data, tuple):
            raise NotImplementedError(
                f"{c.type.display()} columns have no page encoding")
    n = len(batch.columns)
    tensors = [batch.row_mask] + [c.data for c in batch.columns] \
        + [c.validity for c in batch.columns] \
        + ([extra] if extra is not None else [])
    host = _to_host(tensors)
    mask = host[0]
    arrays = [a[mask] for a in host[1:1 + n]]
    valids = [v[mask] for v in host[1 + n:1 + 2 * n]]
    dicts = [c.dictionary if c.type.is_string else None
             for c in batch.columns]
    live_extra = host[-1][mask] if extra is not None else None
    return mask, arrays, valids, dicts, live_extra


def serialize_page(batch: Batch, compress: bool = True) -> bytes:
    """Encode a batch's live rows (copies the batch to the host)."""
    _, arrays, valids, dicts, _ = _host_columns(batch)
    return _encode(batch.schema, arrays, valids, dicts, compress)


def serialize_partitioned(batch: Batch, key_indices: List[int],
                          n_parts: int,
                          compress: bool = True) -> List[Optional[bytes]]:
    """Hash-partition live rows by key columns (value-deterministic, so
    both join sides land matching rows in the same bucket) and encode one
    page per non-empty partition, None for an empty one: the producer
    half of the exchange (reference
    operator/PartitionedOutputOperator.java:48)."""
    from ..parallel.exchange import hash_partition_ids
    pid = hash_partition_ids(batch, list(key_indices), n_parts)
    _, arrays, valids, dicts, pid = _host_columns(batch, pid)
    out: List[Optional[bytes]] = []
    for p in range(n_parts):
        sel = pid == p
        if not sel.any():
            out.append(None)
            continue
        out.append(_encode(batch.schema, [a[sel] for a in arrays],
                           [v[sel] for v in valids], dicts, compress))
    return out


def deserialize_arrays(data: bytes):
    """Decode a page to host numpy: (schema, arrays, validities, dicts,
    n), the spill readback path, which concatenates before the copy to
    the device."""
    if data[:4] != MAGIC:
        raise ValueError("bad page magic")
    version, marker = struct.unpack_from("<BB", data, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported page version {version}")
    payload = data[6:]
    if marker & _MARKER_ZLIB:
        payload = zlib.decompress(payload)
    (hlen,) = struct.unpack_from("<I", payload, 0)
    doc = json.loads(payload[4:4 + hlen].decode("utf-8"))
    n = doc["n"]
    schema = Schema(list(zip(doc["names"],
                             [T.parse_type(t) for t in doc["types"]])))
    dicts = [tuple(d) if d is not None else None for d in doc["dicts"]]
    off = 4 + hlen
    vbytes = (n + 7) // 8
    arrays: List[np.ndarray] = []
    validities: List[np.ndarray] = []
    for typ in schema.types:
        valid = np.unpackbits(
            np.frombuffer(payload, dtype=np.uint8, count=vbytes, offset=off),
            bitorder="little")[:n].astype(bool)
        off += vbytes
        dt = NUMPY_DTYPE[typ.storage_dtype]
        wire_dt = np.dtype(np.uint8) if dt == np.bool_ else dt
        width = getattr(typ, "storage_width", None) or 1
        arr = np.frombuffer(payload, dtype=wire_dt, count=n * width,
                            offset=off)
        off += n * width * wire_dt.itemsize
        if width > 1:
            arr = arr.reshape(n, width)
        if dt == np.bool_:
            arr = arr.astype(bool)
        arrays.append(arr)
        validities.append(valid)
    return schema, arrays, validities, dicts, n


def deserialize_page(data: bytes, device) -> Batch:
    """Decode one page into a batch on ``device``."""
    schema, arrays, validities, dicts, n = deserialize_arrays(data)
    return Batch.from_arrays(schema, arrays, validities, dicts, num_rows=n,
                             device=torch.device(device))
