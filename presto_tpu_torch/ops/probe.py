"""Direct-address join probe on the CUDA kernel ``csrc/probe.cu``.

The counterpart of ``presto_tpu/ops/pallas_join.py``: one pass over the
probe lanes resolves each lane's slot against the direct-address
lo/cnt tables, writes the match count, gathers the packed validity bits
and every payload column. On a CUDA tensor ``direct_probe`` launches the
kernel or raises; on a CPU tensor it runs the plain version. There is no
fallback between the two and no breaker. Under a profile context
(``obs/profiler.py``) each call is timed and charged to the kernel's
record and to the calling operator.

Payload columns are gathered at their own element width (1, 4, 8 or 16
bytes), so no 64-bit or int128 plane split is needed. The launch's
arguments, payload descriptors included, travel by value as one
``ProbeArgs`` structure. Validity travels
as one int32 bit-plane per group of at most 31 payload columns;
``lookup_join_direct`` launches once per group, so joins have no column
limit.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import Batch, Column, Schema, gather_rows
from ..obs import profiler
from . import kernels
from .join import (
    _key_arrays, direct_slot_codes, direct_tables, is_direct_prepared,
    split_prepared,
)

#: launches of the CUDA kernel, and calls of its plain version on CPU
#: tensors (plain integers, bumped under ``kernels.COUNT_LOCK``;
#: chip_smoke.py reads ``launches``)
launches = 0
plain_calls = 0

#: the kernel's record in the profiler's registry
RECORD = profiler.KERNELS.register("direct_probe", "probe",
                                   "presto_tpu_torch/csrc/probe.cu")

#: payload columns whose validity fits one int32 bit-plane
VBITS_COLUMNS = 31
_WIDTHS = (1, 4, 8, 16)


def _width(t: torch.Tensor) -> int:
    return t.element_size() * (t.shape[1] if t.ndim == 2 else 1)


def direct_probe_plain(codes: torch.Tensor, lo_table: torch.Tensor,
                       cnt_table: torch.Tensor, vbits: torch.Tensor,
                       payload: Sequence[torch.Tensor]):
    """Plain PyTorch version of the probe: per-column indexing."""
    ok = codes >= 0
    safe = torch.where(ok, codes, 0).to(torch.int64)
    cnt = torch.where(ok, cnt_table[safe], 0).to(torch.int32)
    hit = cnt > 0
    pos = torch.where(hit, lo_table[safe], 0).to(torch.int64)
    if vbits.shape[0] == 0:      # empty build: nothing can match
        return cnt, torch.zeros_like(cnt), [
            torch.zeros((codes.shape[0],) + tuple(p.shape[1:]),
                        dtype=p.dtype, device=p.device) for p in payload]
    vb = torch.where(hit, vbits[pos], 0).to(torch.int32)
    outs = []
    for p in payload:
        g = p[pos]
        h = hit[:, None] if g.ndim == 2 else hit
        outs.append(torch.where(h, g, torch.zeros((), dtype=p.dtype,
                                                  device=p.device)))
    return cnt, vb, outs


def _check(codes, lo_table, cnt_table, vbits, payload) -> None:
    for name, t in (("codes", codes), ("lo_table", lo_table),
                    ("cnt_table", cnt_table), ("vbits", vbits)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if t.device != codes.device:
            raise ValueError(f"{name} lies on {t.device}, codes on "
                             f"{codes.device}")
    if lo_table.shape != cnt_table.shape:
        raise ValueError("lo_table and cnt_table differ in size")
    if len(payload) > VBITS_COLUMNS:
        raise ValueError(f"at most {VBITS_COLUMNS} payload columns a launch")
    for p in payload:
        if p.device != codes.device:
            raise ValueError("payload lies on another device")
        if p.shape[0] != vbits.shape[0] or p.ndim > 2:
            raise ValueError("payload rows must match the build's vbits")
        if _width(p) not in _WIDTHS:
            raise TypeError(f"payload element width {_width(p)} bytes")


class ColDesc(ctypes.Structure):
    """One payload column of a launch (``ColDesc`` in csrc/probe.cu)."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("width", ctypes.c_longlong)]


class ProbeArgs(ctypes.Structure):
    """The kernel's arguments, passed by value into the launch
    (``ProbeArgs`` in csrc/probe.cu, whose static_asserts state the same
    size and offsets)."""
    _fields_ = [("codes", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("lo_table", ctypes.c_void_p), ("cnt_table", ctypes.c_void_p),
                ("vbits", ctypes.c_void_p), ("n_build", ctypes.c_longlong),
                ("cnt_out", ctypes.c_void_p), ("vb_out", ctypes.c_void_p),
                ("ncols", ctypes.c_int), ("cols", ColDesc * VBITS_COLUMNS)]


def direct_probe(codes: torch.Tensor, lo_table: torch.Tensor,
                 cnt_table: torch.Tensor, vbits: torch.Tensor,
                 payload: Sequence[torch.Tensor]):
    """(cnt, vbits gathered, payload columns gathered) per probe lane.

    ``codes``: int32[n] slot indices, -1 for lanes that must not match.
    ``lo_table``/``cnt_table``: int32[size]. ``vbits`` and ``payload``:
    per build row in SORTED build order. Lanes without a match get zeros."""
    _check(codes, lo_table, cnt_table, vbits, payload)
    return profiler.kernel_call(
        RECORD, codes.device,
        lambda out: _moved_bytes(codes, out[0], payload),
        lambda: _probe(codes, lo_table, cnt_table, vbits, payload))


def _moved_bytes(codes, cnt, payload) -> int:
    """The bound formula's bytes of one launch (profile mode only: it
    reads the lane counts back): codes read on every lane, lo/cnt read on
    live lanes (code >= 0), vbits and payload gathered on matched lanes
    (cnt > 0), and cnt, vb and payload written on every lane."""
    widths = sum(_width(p) for p in payload)
    live = int((codes >= 0).sum())
    matched = int((cnt > 0).sum())
    return (codes.shape[0] * (4 + 4 + 4 + widths) + 8 * live
            + matched * (4 + widths))


def _probe(codes, lo_table, cnt_table, vbits, payload):
    global launches, plain_calls
    if codes.device.type == "cpu":
        with kernels.COUNT_LOCK:
            plain_calls += 1
        RECORD.note_call(launched=False)
        return direct_probe_plain(codes, lo_table, cnt_table, vbits, payload)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    fn = kernels.entry("probe", "direct_probe",
                       (ctypes.c_void_p, ctypes.c_void_p))
    dev = codes.device
    n = codes.shape[0]
    codes = kernels.aligned16(codes)
    lo_table, cnt_table, vbits = (
        t.contiguous() for t in (lo_table, cnt_table, vbits))
    payload = [kernels.aligned16(p) for p in payload]
    with torch.cuda.device(dev):
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
        vb = torch.empty(n, dtype=torch.int32, device=dev)
        outs = [torch.empty((n,) + tuple(p.shape[1:]), dtype=p.dtype,
                            device=dev) for p in payload]
        args = ProbeArgs(codes.data_ptr(), n, lo_table.data_ptr(),
                         cnt_table.data_ptr(), vbits.data_ptr(),
                         vbits.shape[0], cnt.data_ptr(), vb.data_ptr(),
                         len(payload))
        for c, (p, o) in enumerate(zip(payload, outs)):
            args.cols[c] = ColDesc(p.data_ptr(), o.data_ptr(), _width(p))
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(ctypes.addressof(args), stream)
    kernels.check("probe", status, "direct_probe")
    with kernels.COUNT_LOCK:
        launches += 1
    RECORD.note_call(launched=True)
    return cnt, vb, outs


def _kernel_columns(build: Batch, payload: Sequence[int]):
    """The payload columns the kernel gathers, and where the rest go.
    An ARRAY or MAP column is a tuple of tensors of no fixed element
    width, so the kernel gathers the build's row index in its place (one
    int64 column, appended once) and the composite's parts are indexed
    with it; every other column rides the kernel."""
    flat = [ci for ci in payload
            if not isinstance(build.columns[ci].data, tuple)]
    return flat, len(flat) < len(payload)


def sorted_payload(build: Batch, payload: Sequence[int], prepared):
    """Build payload columns in SORTED build order plus their validity
    bit-planes (one int32 plane per group of 31 columns, and one for a
    join without payload). A join computes this once per build and reuses
    it for every probe batch."""
    _, _, perm = split_prepared(prepared)
    flat, routed = _kernel_columns(build, payload)
    cols = [(build.columns[ci].data[perm], build.columns[ci].validity[perm])
            for ci in flat]
    if routed:
        cols.append((perm.to(torch.int64),
                     torch.ones_like(perm, dtype=torch.bool)))
    data, planes = [], []
    for g in range(0, max(len(cols), 1), VBITS_COLUMNS):
        vb = torch.zeros(perm.shape[0], dtype=torch.int32, device=perm.device)
        for j, (d, v) in enumerate(cols[g:g + VBITS_COLUMNS]):
            data.append(d)
            vb = vb | (v.to(torch.int32) << j)
        planes.append(vb)
    return data, planes


def lookup_join_direct(probe: Batch, build: Batch,
                       probe_keys: Sequence[int], build_keys: Sequence[int],
                       payload: Sequence[int], payload_names: Sequence[str],
                       join_type: str, prepared,
                       sorted_cols: Optional[Tuple[List, List]] = None
                       ) -> Batch:
    """``ops/join.lookup_join`` semantics on the probe kernel — a
    unique-build inner/left join against a direct prepared build.
    ``sorted_cols`` is ``sorted_payload(build, payload, prepared)`` when
    the caller keeps it across probe batches."""
    assert join_type in ("inner", "left")
    assert is_direct_prepared(prepared)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    slot, inr = direct_slot_codes(q_ops, prepared)
    live = probe.row_mask & pvalid & inr
    codes = torch.where(live, slot, -1).to(torch.int32)
    lo_table, cnt_table = direct_tables(prepared)
    data, planes = sorted_cols or sorted_payload(build, payload, prepared)
    gathered: List[torch.Tensor] = []
    vbs: List[torch.Tensor] = []
    for g, vbits in enumerate(planes):
        cols = data[g * VBITS_COLUMNS:(g + 1) * VBITS_COLUMNS]
        cnt, vb, outs = direct_probe(codes, lo_table, cnt_table, vbits, cols)
        gathered.extend(outs)
        vbs.append(vb)
    match = cnt > 0            # codes already folded row_mask/valid/inr
    flat, routed = _kernel_columns(build, payload)
    rows = gathered[len(flat)] if routed else None
    out_fields = list(zip(probe.schema.names, probe.schema.types))
    out_cols: List[Column] = list(probe.columns)
    for ci, name in zip(payload, payload_names):
        c = build.columns[ci]
        out_fields.append((name, c.type))
        if ci not in flat:
            out_cols.append(Column(c.type, gather_rows(c.data, rows),
                                   c.validity[rows] & match, c.dictionary))
            continue
        j = flat.index(ci)
        bit = (vbs[j // VBITS_COLUMNS] >> (j % VBITS_COLUMNS)) & 1
        out_cols.append(Column(c.type, gathered[j], (bit > 0) & match,
                               c.dictionary))
    mask = match if join_type == "inner" else probe.row_mask
    return Batch(Schema(out_fields), out_cols, mask)
