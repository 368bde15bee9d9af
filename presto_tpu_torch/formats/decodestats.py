"""Decode accounting of the file readers (``formats/orc.py``,
``formats/parquet.py``), in the process-wide metrics registry:

- ``file_decode_host_seconds_total``: host wall of the readers' decode
  calls (ranged reads, metadata, run-header scans, the host loops of
  strings and decimals, and issuing the device work, without waiting
  for it);
- the device expansions (RLEv2 runs, the Parquet hybrid, IEEE
  assembly) run inside a ``torch.profiler`` range named ``EXPANSION``
  while a profiler records (``expansion()``), after their uploads, so
  the kernels under the range are the expansions' device busy time
  (``chip_smoke.py``'s files phase sums them);
- ``orc_stripes_{read,pruned}_total``, ``orc_files_pruned_total``,
  ``parquet_row_groups_{read,pruned}_total``, ``parquet_files_pruned_total``
  and ``file_partitions_pruned_total``: what the min/max pushdown skipped;
- ``orc_rle_wide_host_decodes_total``: RLEv2 streams with a run wider
  than 56 bits, which the reference's own rule decodes on the host
  (``orc_rle.decode_rle_v2_device``).
"""
from __future__ import annotations

import contextlib

import torch

from ..obs.metrics import REGISTRY

HOST_SECONDS = REGISTRY.counter("file_decode_host_seconds_total")
ORC_STRIPES_READ = REGISTRY.counter("orc_stripes_read_total")
ORC_STRIPES_PRUNED = REGISTRY.counter("orc_stripes_pruned_total")
ORC_FILES_PRUNED = REGISTRY.counter("orc_files_pruned_total")
PARQUET_GROUPS_READ = REGISTRY.counter("parquet_row_groups_read_total")
PARQUET_GROUPS_PRUNED = REGISTRY.counter("parquet_row_groups_pruned_total")
PARQUET_FILES_PRUNED = REGISTRY.counter("parquet_files_pruned_total")
PARTITIONS_PRUNED = REGISTRY.counter("file_partitions_pruned_total")
WIDE_HOST_DECODES = REGISTRY.counter("orc_rle_wide_host_decodes_total")

#: the torch.profiler range name of one device expansion
EXPANSION = "file_decode_expansion"


def expansion():
    """The ``EXPANSION`` range while a torch profiler records, else a
    no-op: its kernels' device time is the expansion's."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(EXPANSION)
    return contextlib.nullcontext()
