"""Sorted-run segment sums: the sort-path GROUP BY's exact 64-bit sums.

The counterpart of ``presto_tpu/ops/pallas_scan.py``. There the sums run
as int32 digit-plane prefix sums in a Pallas TPU kernel; here the CUDA
kernel ``csrc/scan.cu`` scans the int64 values directly (see its header
for the design and bound). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version, which
computes the same bits with ``torch.cumsum`` and boundary gathers.

Contract (as in the reference): group members are CONTIGUOUS RUNS, dead
rows carry zero values, ``starts[g]`` is segment g's first row (so
``starts`` is non-decreasing), and absent segments carry
``starts[g] == n``. Both versions give absent segments 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

#: launches of the CUDA kernel (plain integer; chip_smoke.py reads it)
launches = 0

#: rows a block of the CUDA kernel sums (kTile in csrc/scan.cu); the tests
#: put run boundaries on and around its multiples
TILE_ROWS = 2048

# segment_sum_sorted_i64(values, n, starts, cap, out, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


def _bounds(starts: torch.Tensor, n: int):
    """(prev, ends, at_zero) row indices of each segment's boundaries."""
    s = starts.to(torch.int64)
    prev = (s - 1).clamp(0, n - 1)
    last = torch.full((1,), n - 1, dtype=torch.int64, device=s.device)
    ends = torch.cat([(s[1:] - 1).clamp(0, n - 1), last])
    return prev, ends, s <= 0


def segment_sum_sorted_plain(values: torch.Tensor, starts: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: inclusive prefix sum + boundary differences
    (integer sums wrap mod 2^64)."""
    n = values.shape[0]
    csum = torch.cumsum(values.to(torch.int64), 0)
    prev, ends, at_zero = _bounds(starts[:num_segments], n)
    hi = csum[ends]
    lo = torch.where(at_zero, 0, csum[prev])
    return hi - lo


def _check(values: torch.Tensor, starts: torch.Tensor,
           num_segments: int) -> None:
    if values.dtype != torch.int64 or values.ndim != 1:
        raise TypeError("values must be a 1-D int64 tensor")
    if starts.dtype != torch.int32 or starts.ndim != 1:
        raise TypeError("starts must be a 1-D int32 tensor")
    if starts.shape[0] != num_segments:
        raise ValueError(
            f"starts has {starts.shape[0]} entries, expected {num_segments}")
    if values.device != starts.device:
        raise ValueError("values and starts lie on different devices")
    if values.shape[0] == 0 or num_segments == 0:
        raise ValueError("segment sums need at least one row and segment")


def segment_sum_sorted_i64(values: torch.Tensor, starts: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Exact int64 per-segment sums over sorted runs (wrapping mod 2^64
    like the reference's digit-plane sums). ``starts`` must be
    non-decreasing within [0, n]: the CUDA kernel finds each tile's
    segments by searching it."""
    _check(values, starts, num_segments)
    if values.device.type == "cpu":
        return segment_sum_sorted_plain(values, starts, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    global launches
    fn = kernels.entry("scan", "segment_sum_sorted_i64", _ARGTYPES)
    values = kernels.aligned16(values)
    starts = starts.contiguous()
    with torch.cuda.device(values.device):
        out = torch.empty(num_segments, dtype=torch.int64,
                          device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        status = fn(values.data_ptr(), values.shape[0], starts.data_ptr(),
                    num_segments, out.data_ptr(), stream)
    kernels.check("scan", status, "segment_sum_sorted_i64")
    launches += 1
    return out


def segment_count_sorted(live: torch.Tensor, starts: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Per-segment live-row counts over sorted runs (int64)."""
    return segment_sum_sorted_i64(live.to(torch.int64), starts, num_segments)
