"""Sort / TopN / Limit kernels.

The counterpart of ``presto_tpu/ops/sort.py`` (reference
presto-main/.../operator/PagesIndex.java, OrderByOperator.java,
TopNOperator.java). Rows sort by multiple key operands lexicographically
(successive stable torch sorts from the least significant operand). Dead
rows always sort to the end; null ordering follows Presto defaults (NULLS
LAST for ASC, NULLS FIRST for DESC, reference sql/tree/SortItem.java).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import Batch, Column
from .join import lexsort_permutation


@dataclasses.dataclass(frozen=True)
class SortKey:
    column: int
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = Presto default

    def effective_nulls_first(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return not self.ascending


def _rank_table(vocab: Tuple[str, ...], device) -> torch.Tensor:
    """Order-preserving rank for dictionary codes (+ sentinel slot)."""
    order = np.argsort(np.argsort(np.asarray(vocab, dtype=object)))
    table = np.empty(len(vocab) + 1, dtype=np.int64)
    table[:len(vocab)] = order
    table[-1] = -1
    return torch.from_numpy(table).to(device)


def rank_codes(data: torch.Tensor,
               vocab: Optional[Tuple[str, ...]]) -> torch.Tensor:
    """Map dictionary codes to lexicographic ranks (negative codes -> -1)."""
    table = _rank_table(vocab or (), data.device)
    idx = torch.where(data >= 0, data, table.shape[0] - 1).to(torch.int64)
    return table[idx]


def unrank_table(vocab: Optional[Tuple[str, ...]], device) -> torch.Tensor:
    """Inverse of _rank_table: rank -> dictionary code."""
    order = (np.argsort(np.asarray(vocab, dtype=object))
             if vocab else np.zeros(1))
    return torch.from_numpy(order.astype(np.int64)).to(device)


def _sortable(col: Column, key: SortKey) -> List[torch.Tensor]:
    """One column as ascending-sortable operands: [null_rank, data']."""
    data = col.data
    valid = col.validity
    if key.effective_nulls_first():
        null_rank = valid.to(torch.int32)
    else:
        null_rank = (~valid).to(torch.int32)
    if data.ndim == 2:
        raise NotImplementedError("sorting long decimals is not ported")
    if col.type.is_string:
        data = rank_codes(data, col.dictionary)
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    if not key.ascending:
        # floats negate; integers flip bits (no INT_MIN overflow)
        data = -data if data.is_floating_point() else ~data
    # NULL rows tie on null_rank; neutralize their data operand
    data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                device=data.device))
    return [null_rank, data]


def sort_permutation(batch: Batch, keys: Sequence[SortKey]) -> torch.Tensor:
    """Stable sort permutation of rows by keys; dead rows sort last."""
    operands = [(~batch.row_mask).to(torch.int32)]
    for k in keys:
        operands.extend(_sortable(batch.columns[k.column], k))
    return lexsort_permutation(operands)


def permute_batch(batch: Batch, perm: torch.Tensor) -> Batch:
    """Gather every row-aligned array of a batch by ``perm``."""
    cols = [Column(c.type, c.data[perm], c.validity[perm], c.dictionary)
            for c in batch.columns]
    return Batch(batch.schema, cols, batch.row_mask[perm])


def sort_batch(batch: Batch, keys: Sequence[SortKey]) -> Batch:
    """Stable sort of live rows by keys; dead rows go to the end."""
    return permute_batch(batch, sort_permutation(batch, keys))


def limit(batch: Batch, n: int) -> Batch:
    """Keep the first n live rows (in current physical order)."""
    live_rank = torch.cumsum(batch.row_mask.to(torch.int64), 0)
    return Batch(batch.schema, batch.columns,
                 batch.row_mask & (live_rank <= n))


def top_n(batch: Batch, keys: Sequence[SortKey], n: int) -> Batch:
    """ORDER BY ... LIMIT n (reference TopNOperator.java): sort, then
    mask."""
    return limit(sort_batch(batch, keys), n)
