"""Slot sums: the dense GROUP BY's per-slot sums and counts.

``out[s]`` is the sum of ``x`` over the lanes whose group id is ``s``.
On a CUDA tensor the wrapper launches the block-privatized kernel of
``csrc/slotsum.cu`` (see its header for the design and bound) or
raises; on a CPU tensor it runs the plain version, ``index_add_`` into
zeros. Int64 sums are bit for bit the same in both (mod 2^64), float64
sums differ by the order of addition only, and a bool column is summed
as a count of its trues. Under a profile context (``obs/profiler.py``)
each call is timed and charged to the kernel's record and to the
calling operator.

``routed`` is the reducers' dispatch rule: a 1-D float64, int64 or bool
sum over at most ``MAX_SLOTS`` slots goes through ``slot_sum`` (the
kernel on CUDA, the plain version on the CPU). Other shapes keep
``index_add_``, whose atomics do not contend once the slots are many
(the stats-bounded dense path's up to 2^21 slots, the sort path's large
capacities) or the values carry a trailing width (digit planes).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..obs import profiler
from ..obs.metrics import REGISTRY
from . import kernels

#: launches of the CUDA kernel, and calls of its plain version on CPU
#: tensors (plain integers, bumped under ``kernels.COUNT_LOCK``;
#: chip_smoke.py reads ``launches``)
launches = 0
plain_calls = 0

#: the kernel's record in the profiler's registry
RECORD = profiler.KERNELS.register("slot_sum", "slotsum",
                                   "presto_tpu_torch/csrc/slotsum.cu")

#: the most slots the kernel takes: the unbounded dense path's 4096 key
#: slots (``aggregation._DENSE_GROUP_LIMIT``) and its slot of dead lanes
MAX_SLOTS = 4097

#: reducer sums on CUDA that launched the kernel, and those that took
#: ``index_add_`` because of their shape: the mechanism's hit share
KERNEL_SUMS = REGISTRY.counter("slot_sum_kernel_total")
INDEX_ADD_SUMS = REGISTRY.counter("slot_sum_index_add_total")

#: input dtype -> the kernel's kind code (the C entry's ``kind``)
_KINDS = {torch.float64: 0, torch.int64: 1, torch.bool: 2}

# slot_sum(kind, gid, x, n, slots, out, scratch, max_blocks, stream)
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
#: bytes ahead of the partial sums in the scratch (the kernel's ticket)
_TICKET_BYTES = 16
#: device index -> the most blocks a launch uses (2 an SM)
_MAX_BLOCKS: Dict[int, int] = {}


def routed(x: torch.Tensor, slots: int) -> bool:
    """Whether a reducer's sum of ``x`` over ``slots`` slots goes
    through ``slot_sum``; a sum on CUDA counts under the route it
    takes."""
    fits = x.dtype in _KINDS and x.ndim == 1 and 1 <= slots <= MAX_SLOTS
    if x.device.type == "cuda":
        (KERNEL_SUMS if fits else INDEX_ADD_SUMS).inc()
    return fits


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int64 if dtype == torch.bool else dtype


def slot_sum_plain(gid: torch.Tensor, x: torch.Tensor,
                   slots: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into zeros (a bool column
    as int64 counts)."""
    dtype = _out_dtype(x.dtype)
    out = torch.zeros(slots, dtype=dtype, device=x.device)
    return out.index_add_(0, gid, x.to(dtype))


def _check(gid: torch.Tensor, x: torch.Tensor, slots: int) -> None:
    if gid.dtype != torch.int64 or gid.ndim != 1:
        raise TypeError("gid must be a 1-D int64 tensor")
    if x.dtype not in _KINDS or x.ndim != 1:
        raise TypeError("x must be a 1-D float64, int64 or bool tensor")
    if x.shape[0] != gid.shape[0]:
        raise ValueError(f"x has {x.shape[0]} lanes, gid {gid.shape[0]}")
    if x.device != gid.device:
        raise ValueError("gid and x lie on different devices")
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"{slots} slots: the kernel takes 1 to "
                         f"{MAX_SLOTS}")


def slot_sum(gid: torch.Tensor, x: torch.Tensor,
             slots: int) -> torch.Tensor:
    """Per-slot sums of ``x`` over the group ids ``gid`` (each in
    [0, slots)): float64 for float64 input, int64 for int64 (wrapping
    mod 2^64) and for bool (the count of trues)."""
    _check(gid, x, slots)
    # the bound formula's bytes: gid and x read, the sums written
    return profiler.kernel_call(
        RECORD, x.device,
        lambda out: (8 + x.element_size()) * x.shape[0] + 8 * slots,
        lambda: _slot_sum(gid, x, slots))


def _max_blocks(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    blocks = _MAX_BLOCKS.get(index)
    if blocks is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        blocks = _MAX_BLOCKS[index] = 2 * sms
    return blocks


def _slot_sum(gid: torch.Tensor, x: torch.Tensor,
              slots: int) -> torch.Tensor:
    global launches, plain_calls
    if x.device.type == "cpu":
        with kernels.COUNT_LOCK:
            plain_calls += 1
        RECORD.note_call(launched=False)
        return slot_sum_plain(gid, x, slots)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fn = kernels.entry("slotsum", "slot_sum", _ARGTYPES)
    gid = kernels.aligned16(gid)
    x = kernels.aligned16(x)
    blocks = _max_blocks(x.device)
    with torch.cuda.device(x.device):
        out = torch.empty(slots, dtype=_out_dtype(x.dtype), device=x.device)
        scratch = torch.empty(_TICKET_BYTES + 8 * blocks * slots,
                              dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(_KINDS[x.dtype], gid.data_ptr(), x.data_ptr(),
                    x.shape[0], slots, out.data_ptr(), scratch.data_ptr(),
                    blocks, stream)
    kernels.check("slotsum", status, "slot_sum")
    with kernels.COUNT_LOCK:
        launches += 1
    RECORD.note_call(launched=True)
    return out
