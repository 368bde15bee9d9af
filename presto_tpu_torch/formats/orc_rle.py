"""ORC integer RLEv2 and boolean/byte RLE decoding.

The counterpart of ``presto_tpu/formats/orc_rle.py`` (reference
presto-orc/.../stream/LongInputStreamV2.java, LongBitPacker.java,
BooleanInputStream.java, ByteInputStream.java). The decode splits as
in the reference:

- the HOST scans run headers only (a few bytes per run, sequential,
  small beside the packed payload) into a flat run table
  (``scan_rle_v2``);
- the DEVICE expands all runs at once (``_expand_runs``, plain PyTorch
  on the caller's device): every output element finds its run by
  ``searchsorted``, computes its absolute bit position, gathers an
  8-byte big-endian window of the raw stream and shifts and masks its
  value out. DELTA runs resolve through one cumulative sum with per-run
  carry subtraction; PATCHED_BASE runs (rare) decode on the host into a
  table the expansion gathers from.

The window is built in int64, which torch supports on CUDA (uint64 it
mostly does not): the eight shifted bytes occupy disjoint bits, so their
int64 sum wraps to the same bit pattern as the reference's uint64 sum,
and for widths of at most 56 bits the arithmetic right shift followed by
the ``width``-bit mask keeps only original bits, as the logical shift
does. Streams with a wider run decode on the host, as the reference
decides (``decode_rle_v2_device``), and are counted in
``orc_rle_wide_host_decodes_total``.

``decode_rle_v2_numpy`` is the reference's host decoder, kept as the
oracle of the tests and for the small streams the readers decode on the
host (string lengths, decimal scales).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..batch import bucket_capacity
from .decodestats import WIDE_HOST_DECODES, expansion

# 5-bit width code -> bit width (ORC spec "Direct" width encoding)
_WIDTH_TABLE = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]

K_SHORT_REPEAT, K_DIRECT, K_PATCHED, K_DELTA = 0, 1, 2, 3

#: the widest run the 8-byte window decodes (a value may start at any of
#: the 8 bit offsets of its first byte)
MAX_WINDOW_WIDTH = 56


def _decode_width(code: int) -> int:
    return _WIDTH_TABLE[code]


def _closest_fixed_bits(bits: int) -> int:
    """Round up to the nearest encodable fixed width (ORC spec
    closestFixedBits; reference LongBitPacker widths)."""
    for w in _WIDTH_TABLE:
        if w >= bits:
            return w
    return 64


def _zigzag_np(v):
    if isinstance(v, np.ndarray):
        # a logical shift: a 64-bit encoded value keeps its top bit
        return (v.view(np.uint64) >> np.uint64(1)).view(np.int64) ^ -(v & 1)
    return (v >> 1) ^ -(v & 1)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _read_svarint(data: bytes, pos: int) -> Tuple[int, int]:
    v, pos = _read_varint(data, pos)
    return (v >> 1) ^ -(v & 1), pos


@dataclasses.dataclass
class RunTable:
    """Flat per-run decode parameters (host numpy, device-uploadable)."""

    n: int                       # total output values
    kinds: np.ndarray            # int32[r]
    out_start: np.ndarray        # int64[r]  first output index of run
    bit_start: np.ndarray        # int64[r]  absolute bit offset of payload
    widths: np.ndarray           # int32[r]  payload bit width (0 = none)
    literals: np.ndarray         # int64[r]  short-repeat value / delta base
    delta_bases: np.ndarray      # int64[r]  first delta (signed)
    patch_offset: np.ndarray     # int64[r]  offset into patched values
    patched: np.ndarray          # int64[*]  pre-decoded PATCHED_BASE values
    signed: bool


def scan_rle_v2(data: bytes, n: int, signed: bool) -> RunTable:
    """Sequential header scan (host): O(runs), not O(values)."""
    kinds: List[int] = []
    out_start: List[int] = []
    bit_start: List[int] = []
    widths: List[int] = []
    literals: List[int] = []
    delta_bases: List[int] = []
    patch_offset: List[int] = []
    patched: List[int] = []

    pos = 0
    out = 0
    while out < n and pos < len(data):
        header = data[pos]
        enc = header >> 6
        if enc == 0:                      # SHORT_REPEAT
            width = ((header >> 3) & 7) + 1
            count = (header & 7) + 3
            value = int.from_bytes(data[pos + 1:pos + 1 + width], "big")
            if signed:
                value = _zigzag_np(value)
            kinds.append(K_SHORT_REPEAT)
            out_start.append(out)
            bit_start.append(0)
            widths.append(0)
            literals.append(value)
            delta_bases.append(0)
            patch_offset.append(0)
            pos += 1 + width
            out += count
        elif enc == 1:                    # DIRECT
            width = _decode_width((header >> 1) & 0x1F)
            count = ((header & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            kinds.append(K_DIRECT)
            out_start.append(out)
            bit_start.append(pos * 8)
            widths.append(width)
            literals.append(0)
            delta_bases.append(0)
            patch_offset.append(0)
            pos += (count * width + 7) // 8
            out += count
        elif enc == 3:                    # DELTA
            wcode = (header >> 1) & 0x1F
            width = _decode_width(wcode) if wcode else 0
            count = ((header & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            if signed:
                base, pos = _read_svarint(data, pos)
            else:
                base, pos = _read_varint(data, pos)
            delta_base, pos = _read_svarint(data, pos)
            kinds.append(K_DELTA)
            out_start.append(out)
            bit_start.append(pos * 8)
            widths.append(width)
            literals.append(base)
            delta_bases.append(delta_base)
            patch_offset.append(0)
            if width:
                pos += (max(count - 2, 0) * width + 7) // 8
            out += count
        else:                             # PATCHED_BASE: host decode
            vals, pos = _decode_patched_base(data, pos)
            kinds.append(K_PATCHED)
            out_start.append(out)
            bit_start.append(0)
            widths.append(0)
            literals.append(0)
            delta_bases.append(0)
            patch_offset.append(len(patched))
            patched.extend(int(v) for v in vals)
            out += len(vals)
    if out < n:
        raise ValueError(f"RLEv2 stream exhausted at {out}/{n} values")
    return RunTable(
        n=n,
        kinds=np.asarray(kinds, dtype=np.int32),
        out_start=np.asarray(out_start, dtype=np.int64),
        bit_start=np.asarray(bit_start, dtype=np.int64),
        widths=np.asarray(widths, dtype=np.int32),
        literals=np.asarray(literals, dtype=np.int64),
        delta_bases=np.asarray(delta_bases, dtype=np.int64),
        patch_offset=np.asarray(patch_offset, dtype=np.int64),
        patched=np.asarray(patched or [0], dtype=np.int64),
        signed=signed,
    )


def _unpack_fields(data: bytes, bp: np.ndarray,
                   width: np.ndarray) -> np.ndarray:
    """Big-endian fields of ``width`` (<= 56) bits at absolute bit
    positions ``bp``, all at once: each from the 8-byte window at its
    first byte (the device expansion's method, in numpy's uint64). The
    caller checks that every field lies inside ``data``."""
    padded = np.zeros(len(data) + 8, dtype=np.uint8)
    padded[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    rows = np.lib.stride_tricks.sliding_window_view(padded, 8)[bp >> 3]
    window = rows.view(">u8").reshape(-1).astype(np.uint64)
    width = np.asarray(width, dtype=np.int64)
    shift = (64 - (bp & 7) - width).astype(np.uint64)
    mask = (np.uint64(1) << width.astype(np.uint64)) - np.uint64(1)
    return ((window >> shift) & mask).astype(np.int64)


def _unpack_bits_np(data: bytes, bit_pos: int, width: int,
                    count: int) -> np.ndarray:
    """Big-endian bit unpack on host (reference LongBitPacker.java).
    Fields of at most 56 bits that lie inside ``data`` unpack at once
    (``_unpack_fields``); the rest take the reference's bit loop."""
    last = bit_pos + count * width - 1
    if count and width <= MAX_WINDOW_WIDTH and last >> 3 < len(data):
        bp = bit_pos + np.arange(count, dtype=np.int64) * width
        return _unpack_fields(data, bp, np.full(count, width))
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        bp = bit_pos + i * width
        acc = 0
        remaining = width
        while remaining > 0:
            byte = data[bp >> 3]
            avail = 8 - (bp & 7)
            take = min(avail, remaining)
            bits = (byte >> (avail - take)) & ((1 << take) - 1)
            acc = (acc << take) | bits
            bp += take
            remaining -= take
        # a 64-bit pattern keeps its bits (two's complement), as numpy's
        # wrapping store does in the reference
        out[i] = acc - (1 << 64) if acc >= 1 << 63 else acc
    return out


def _decode_patched_base(data: bytes, pos: int) -> Tuple[np.ndarray, int]:
    header = data[pos]
    width = _decode_width((header >> 1) & 0x1F)
    count = ((header & 1) << 8 | data[pos + 1]) + 1
    third, fourth = data[pos + 2], data[pos + 3]
    base_bytes = ((third >> 5) & 7) + 1
    patch_width = _decode_width(third & 0x1F)
    patch_gap_width = ((fourth >> 5) & 7) + 1
    patch_count = fourth & 0x1F
    pos += 4
    base = int.from_bytes(data[pos:pos + base_bytes], "big")
    sign_mask = 1 << (base_bytes * 8 - 1)
    if base & sign_mask:
        base = -(base & (sign_mask - 1))
    pos += base_bytes
    values = _unpack_bits_np(data, pos * 8, width, count)
    pos += (count * width + 7) // 8
    # patch-list entries are (gap, patch) packed at
    # closestFixedBits(gap_width + patch_width) bits (ORC spec)
    pl_width = _closest_fixed_bits(patch_gap_width + patch_width)
    patches = _unpack_bits_np(data, pos * 8, pl_width, patch_count)
    pos += (patch_count * pl_width + 7) // 8
    idx = 0
    for p in patches:
        gap = int(p) >> patch_width
        patch = int(p) & ((1 << patch_width) - 1)
        idx += gap
        values[idx] |= patch << width
    return values + base, pos


def decode_rle_v2_numpy(data: bytes, n: int, signed: bool) -> np.ndarray:
    """Reference decoder: full host decode (oracle and host path). The
    DIRECT runs of at most 56 bits that lie inside ``data`` unpack in one
    ``_unpack_fields`` call; the other runs take the per-run loop."""
    out = np.empty(n, dtype=np.int64)
    rt = scan_rle_v2(data, n, signed)
    bounds = np.append(rt.out_start, n)
    counts = np.diff(bounds)
    widths = rt.widths.astype(np.int64)
    last_bit = rt.bit_start + counts * widths - 1
    direct = ((rt.kinds == K_DIRECT) & (widths <= MAX_WINDOW_WIDTH)
              & ((last_bit >> 3) < len(data)))
    if direct.any():
        run = np.repeat(np.flatnonzero(direct), counts[direct])
        first = np.cumsum(counts[direct]) - counts[direct]
        i = (np.arange(run.shape[0], dtype=np.int64)
             - np.repeat(first, counts[direct]))
        vals = _unpack_fields(data, rt.bit_start[run] + i * widths[run],
                              widths[run])
        out[rt.out_start[run] + i] = _zigzag_np(vals) if signed else vals
    for i in np.flatnonzero(~direct):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        count = hi - lo
        kind = rt.kinds[i]
        if kind == K_SHORT_REPEAT:
            out[lo:hi] = rt.literals[i]
        elif kind == K_DIRECT:
            vals = _unpack_bits_np(data, int(rt.bit_start[i]),
                                   int(rt.widths[i]), count)
            if signed:
                vals = _zigzag_np(vals)
            out[lo:hi] = vals
        elif kind == K_DELTA:
            base, db = int(rt.literals[i]), int(rt.delta_bases[i])
            vals = np.empty(count, dtype=np.int64)
            vals[0] = base
            if count > 1:
                vals[1] = base + db
            if count > 2:
                w = int(rt.widths[i])
                if w:
                    deltas = _unpack_bits_np(
                        data, int(rt.bit_start[i]), w, count - 2)
                else:
                    deltas = np.full(count - 2, abs(db), dtype=np.int64)
                sign = 1 if db >= 0 else -1
                vals[2:] = vals[1] + sign * np.cumsum(deltas)
            out[lo:hi] = vals
        else:
            po = int(rt.patch_offset[i])
            out[lo:hi] = rt.patched[po:po + count]
    return out


# ---------------------------------------------------------------------------
# Device expansion
# ---------------------------------------------------------------------------

def _upload(rt: RunTable, device: torch.device) -> RunTable:
    """The run table with its arrays as tensors on ``device``."""
    return dataclasses.replace(rt, **{
        f.name: torch.from_numpy(getattr(rt, f.name)).to(device)
        for f in dataclasses.fields(rt) if f.name not in ("n", "signed")})


def _expand_runs(stream: torch.Tensor, rt: RunTable, n_cap: int,
                 device: torch.device) -> torch.Tensor:
    """int64[n_cap] values of the run table ``rt`` (uploaded to
    ``device``, ``_upload``) over the raw stream bytes ``stream`` (uint8
    on ``device``); lanes past ``rt.n`` continue the last run, as in the
    reference (the caller zeroes them)."""
    out_start, kinds, bit_start, widths = (rt.out_start, rt.kinds,
                                           rt.bit_start, rt.widths)
    literals, delta_bases = rt.literals, rt.delta_bases
    patch_offset, patched = rt.patch_offset, rt.patched
    n_runs = out_start.shape[0]
    j = torch.arange(n_cap, dtype=torch.int64, device=device)
    r = (torch.searchsorted(out_start, j, right=True) - 1).clamp(0,
                                                                n_runs - 1)
    i = j - out_start[r]                       # index within the run
    kind = kinds[r]
    width = widths[r].to(torch.int64)

    # ---- bit extraction (DIRECT payload / DELTA deltas) ----
    # DELTA payload holds deltas for in-run indices >= 2
    di = torch.where(kind == K_DELTA, (i - 2).clamp(min=0), i)
    bp = bit_start[r] + di * width
    byte0 = bp >> 3
    shift_in = bp & 7
    # an 8-byte big-endian window starting at byte0, summed in int64
    offs = torch.arange(8, dtype=torch.int64, device=device)
    idx = (byte0[:, None] + offs[None, :]).clamp(0, stream.shape[0] - 1)
    window = (stream[idx].to(torch.int64) << (8 * (7 - offs))[None, :]) \
        .sum(dim=1)
    # value = bits [shift_in, shift_in + width) of the window (<= 56 bits)
    shift_out = (64 - shift_in - width).clamp(0, 63)
    mask = (torch.ones_like(width) << width.clamp(0, 63)) - 1
    raw = (window >> shift_out) & mask
    raw = torch.where(width > 0, raw, 0)

    # ---- DIRECT ----
    direct_val = (raw >> 1) ^ -(raw & 1) if rt.signed else raw

    # ---- DELTA: value(i>=2) = base + delta_base + sign * sum(d_2..d_i).
    # One cumulative sum of per-element delta contributions; each element
    # subtracts the sum just before its run, which cancels all prior
    # runs' contributions.
    db = delta_bases[r]
    sign = torch.where(db >= 0, 1, -1)
    dmag = torch.where(width > 0, raw, db.abs())
    contrib = torch.where((kind == K_DELTA) & (i >= 2), sign * dmag, 0)
    cum = torch.cumsum(contrib, 0)
    run_first = out_start[r].clamp(0, n_cap)
    cum_before_run = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=device), cum])[run_first]
    lit = literals[r]
    delta_val = lit + torch.where(i >= 1, db, 0) + (cum - cum_before_run)

    # ---- SHORT_REPEAT / PATCHED ----
    patched_idx = (patch_offset[r] + i).clamp(0, patched.shape[0] - 1)
    patched_val = patched[patched_idx]
    return torch.where(kind == K_SHORT_REPEAT, lit,
                       torch.where(kind == K_DIRECT, direct_val,
                                   torch.where(kind == K_DELTA, delta_val,
                                               patched_val)))


def decode_rle_v2_device(data: bytes, n: int, signed: bool,
                         capacity: Optional[int] = None, *,
                         device) -> torch.Tensor:
    """Decode an RLEv2 stream to int64[capacity] on ``device``.

    The host scans the run headers; the device expands. Output is padded
    to ``capacity`` (``bucket_capacity(n)`` when not given) with zeros:
    the reference leaves the last run's continuation there, which a dead
    lane of a string column would carry as a code outside its
    vocabulary."""
    device = torch.device(device)
    cap = capacity or bucket_capacity(n)
    rt = scan_rle_v2(data, n, signed)
    if np.any(rt.widths > MAX_WINDOW_WIDTH):
        # the 8-byte window cannot hold a run over 56 bits at every bit
        # offset: the reference decodes such a stream on the host
        WIDE_HOST_DECODES.inc()
        out = np.zeros(cap, dtype=np.int64)
        out[:n] = decode_rle_v2_numpy(data, n, signed)
        return torch.from_numpy(out).to(device)
    if len(rt.kinds) == 0:
        return torch.zeros(cap, dtype=torch.int64, device=device)
    stream = torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).copy()).to(device)
    runs = _upload(rt, device)
    with expansion():
        out = _expand_runs(stream, runs, cap, device)
        out[n:] = 0
    return out


# ---------------------------------------------------------------------------
# Boolean / byte RLE (present streams, RLEv1-style byte runs)
# ---------------------------------------------------------------------------

def decode_byte_rle(data: bytes, n: int) -> np.ndarray:
    """ORC byte-RLE (reference stream/ByteInputStream.java): header
    0..127 = run of (header+3) copies of next byte; 129..255 = 256-header
    literal bytes follow."""
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    filled = 0
    while filled < n and pos < len(data):
        h = data[pos]
        pos += 1
        if h < 128:
            count = h + 3
            out[filled:filled + count] = data[pos]
            pos += 1
        else:
            count = 256 - h
            out[filled:filled + count] = np.frombuffer(
                data[pos:pos + count], dtype=np.uint8)
            pos += count
        filled += count
    return out[:n]


def decode_present(data: bytes, n_rows: int) -> np.ndarray:
    """Present stream -> bool[n_rows] validity (bit-packed big-endian over
    byte-RLE; reference stream/BooleanInputStream.java)."""
    n_bytes = (n_rows + 7) // 8
    packed = decode_byte_rle(data, n_bytes)
    bits = np.unpackbits(packed)[:n_rows]
    return bits.astype(bool)
