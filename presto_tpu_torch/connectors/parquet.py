"""Parquet connector: a table is a directory of parquet files.

The counterpart of ``presto_tpu/connectors/parquet.py``, the Parquet
sibling of ``connectors/orc.py`` on the shared directory-connector base
(reference presto-hive/.../HivePageSourceProvider.java dispatching to
parquet/ParquetPageSourceFactory.java); row-group min/max pruning from
footer statistics rides the scan pushdown (reference
predicate/TupleDomainParquetPredicate.java). Writes go straight from the
batches' storage to ``formats/parquet.write_parquet_batches``, which
writes the bytes the reference writes through python values.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..formats.parquet import ParquetReader, write_parquet_batches
from .filebase import FileConnectorBase
from .spi import PageSource


class _ParquetPageSource(PageSource):
    def __init__(self, conn: "ParquetConnector", path: str,
                 columns: Sequence[str], pushdown, device: torch.device):
        self.conn = conn
        self.path = path
        self.columns = list(columns)
        self.pushdown = pushdown
        self.device = device

    def batches(self):
        yield from self.conn.reader(self.path).batches(
            self.columns, self.pushdown, device=self.device)


class ParquetConnector(FileConnectorBase):
    name = "parquet"
    extension = ".parquet"

    def open_reader(self, path: str) -> ParquetReader:
        return ParquetReader(path)

    def write_file(self, path: str, schema, batches) -> int:
        return write_parquet_batches(path, schema, batches)

    def make_page_source(self, path, columns, pushdown,
                         device) -> PageSource:
        return _ParquetPageSource(self, path, columns, pushdown, device)
